"""The port's downstream tools (arriba_tpu_torch/tools) against the JAX
package's: each tool's command line on the same inputs, the port's with
jax and the JAX package made unimportable, must write byte-equal output
(VCF, annotated TSV, SAM, virus table, PDF). SOURCE_DATE_EPOCH=0 pins the
PDF's creation date for both runs."""

import os
import pathlib
import subprocess
import sys

import pytest

from . import scenario
from .test_tools import draw_inputs  # noqa: F401  (a fixture)
from .torch_cli import BLOCKER, REPO, run_cli

# the port's tool as ``python -m``, with the blocker installed first
PORT_TOOL = BLOCKER + r"""
import runpy

module = sys.argv.pop(1)
sys.argv[0] = module
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def run_tool(package, name, args):
    """(returncode, stderr) of ``python -m <package>.tools.<name> args``."""
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("ARRIBA_TPU")}
    env.update(JAX_PLATFORMS="cpu", SOURCE_DATE_EPOCH="0",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p]))
    module = f"{package}.tools.{name}"
    if package == "arriba_tpu_torch":
        env["ARRIBA_TPU_TORCH_DEVICE"] = "cpu"
        command = [sys.executable, "-c", PORT_TOOL, module]
    else:
        command = [sys.executable, "-m", module]
    result = subprocess.run(command + [str(a) for a in args], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=300)
    return result.returncode, result.stderr


@pytest.fixture(scope="module")
def samples(tmp_path_factory, draw_inputs):  # noqa: F811
    """The translocation sample with the JAX package's fusions.tsv, the
    viral sample, and tests/test_tools.py's drawing inputs (a GTF with two
    transcripts of GENE1, protein domains, cytobands, a STAR-Fusion table
    and an intergenic breakpoint)."""
    root = tmp_path_factory.mktemp("torch_tools")
    translocation = root / "translocation"
    translocation.mkdir()
    args = scenario.translocation_sample(translocation)
    rc, fusions, _, _, err = run_cli("arriba_tpu", args, translocation,
                                     "fusions", {})
    assert rc == 0, err[-2000:]
    viral = root / "viral"
    viral.mkdir()
    scenario.viral_sample(viral)
    draw = draw_inputs
    (draw / "star.tsv").write_text(
        "#FusionName\tJunctionReadCount\tSpanningFragCount\tLeftGene\t"
        "LeftBreakpoint\tRightGene\tRightBreakpoint\n"
        "GENE1--GENE2\t7\t3\tGENE1^G1\t1:3000:+\tGENE2^G2\t2:5001:+\n")
    (draw / "intergenic.tsv").write_text(
        "#gene1\tgene2\tstrand1(gene/fusion)\tstrand2(gene/fusion)\t"
        "breakpoint1\tbreakpoint2\tsite1\tsite2\ttype\tsplit_reads1\t"
        "split_reads2\tdiscordant_mates\tconfidence\treading_frame\t"
        "gene_id1\tgene_id2\ttranscript_id1\ttranscript_id2\t"
        "fusion_transcript\n"
        "1:3500\tGENE2\t./.\t+/+\t1:3500\t2:5001\tintergenic\tsplice-site\t"
        "translocation\t2\t1\t1\tmedium\t.\t.\tG2\t.\tT2\t.\n")
    (translocation / "cytobands.tsv").write_text(
        "contig\tstart\tend\tname\tgiemsa\n"
        "1\t0\t8000\tp11\tgneg\n1\t8000\t20000\tq11\tgpos50\n"
        "2\t0\t20000\tq\tgneg\n")
    return {"t": translocation, "v": viral, "d": draw}


# (tool, its arguments with {t}, {v}, {d} for the sample directories and
# {out} for the output's path prefix): every tool, and draw_fusions with the
# options tests/test_tools.py exercises
CASES = {
    "vcf": ("convert_fusions_to_vcf",
            ["{t}/genome.fa", "{t}/fusions.tsv", "{out}.vcf"]),
    "exon_numbers": ("annotate_exon_numbers",
                     ["{t}/fusions.tsv", "{t}/genes.gtf", "{out}.tsv"]),
    "exon_numbers_gtf_numbers": ("annotate_exon_numbers",
                                 ["{d}/fusions.tsv", "{d}/genes.gtf",
                                  "{out}.tsv"]),
    "supporting_alignments": ("extract_fusion_supporting_alignments",
                              ["{t}/fusions.tsv", "{t}/aligned.sam",
                               "{out}"]),
    "virus_expression": ("quantify_virus_expression",
                         ["{v}/aligned.sam", "{out}.tsv"]),
    "draw": ("draw_fusions",
             ["--fusions={t}/fusions.tsv", "--annotation={t}/genes.gtf",
              "--output={out}.pdf", "--alignments={t}/aligned.sam"]),
    "draw_circos": ("draw_fusions",
                    ["--fusions={t}/fusions.tsv", "--annotation={t}/genes.gtf",
                     "--output={out}.pdf", "--cytobands={t}/cytobands.tsv",
                     "--minConfidenceForCircosPlot=low"]),
    "draw_full_report": ("draw_fusions",
                         ["--fusions={d}/fusions.tsv",
                          "--annotation={d}/genes.gtf", "--output={out}.pdf",
                          "--alignments={d}/aligned.sam",
                          "--cytobands={d}/cytobands.tsv",
                          "--proteinDomains={d}/domains.gff3",
                          "--sampleName=SAMPLE",
                          "--minConfidenceForCircosPlot=low"]),
    "draw_fusion_panel": ("draw_fusions",
                          ["--fusions={d}/fusions.tsv",
                           "--annotation={d}/genes.gtf",
                           "--output={out}.pdf",
                           "--cytobands={d}/cytobands.tsv",
                           "--proteinDomains={d}/domains.gff3",
                           "--plotPanels=fusion"]),
    "draw_canonical": ("draw_fusions",
                       ["--fusions={d}/fusions.tsv",
                        "--annotation={d}/genes.gtf", "--output={out}.pdf",
                        "--transcriptSelection=canonical",
                        "--plotPanels=fusion"]),
    "draw_coverage": ("draw_fusions",
                      ["--fusions={d}/fusions.tsv",
                       "--annotation={d}/genes.gtf", "--output={out}.pdf",
                       "--transcriptSelection=coverage",
                       "--plotPanels=fusion"]),
    "draw_unsquished": ("draw_fusions",
                        ["--fusions={d}/fusions.tsv",
                         "--annotation={d}/genes.gtf", "--output={out}.pdf",
                         "--squishIntrons=FALSE", "--pdfWidth=8",
                         "--pdfHeight=6", "--fontSize=1.3",
                         "--fixedScale=20000", "--plotPanels=fusion"]),
    "draw_star_fusion": ("draw_fusions",
                         ["--fusions={d}/star.tsv",
                          "--annotation={d}/genes.gtf", "--output={out}.pdf",
                          "--plotPanels=fusion,readcounts"]),
    "draw_intergenic": ("draw_fusions",
                        ["--fusions={d}/intergenic.tsv",
                         "--annotation={d}/genes.gtf", "--output={out}.pdf",
                         "--squishIntrons=FALSE",
                         "--showIntergenicVicinity=2000,2000,2000,2000",
                         "--plotPanels=fusion"]),
}


def _outputs(prefix: pathlib.Path) -> dict:
    """{file name with the prefix cut to its suffix: bytes} of what a run
    wrote beside prefix."""
    return {path.name[len(prefix.name):]: path.read_bytes()
            for path in sorted(prefix.parent.glob(prefix.name + "*"))}


@pytest.mark.parametrize("case", list(CASES))
def test_port_tool_matches_jax_package(samples, tmp_path, case):
    name, template = CASES[case]
    outputs = {}
    for package in ("arriba_tpu", "arriba_tpu_torch"):
        prefix = tmp_path / package / "out"
        prefix.parent.mkdir()
        args = [a.format(out=prefix, **samples) for a in template]
        rc, err = run_tool(package, name, args)
        assert rc == 0, f"{package}: {err[-2000:]}"
        outputs[package] = _outputs(prefix)
    assert outputs["arriba_tpu"], "the tool wrote nothing"
    assert all(outputs["arriba_tpu"].values())
    assert outputs["arriba_tpu_torch"] == outputs["arriba_tpu"]
    if name == "draw_fusions":
        assert next(iter(outputs["arriba_tpu"].values())).startswith(b"%PDF")


def test_port_tools_import_no_jax_and_no_matplotlib():
    """Importing every tool of the port loads neither jax, the JAX package
    nor matplotlib (draw_fusions imports it only to render)."""
    script = BLOCKER + r"""
import importlib
for name in ("convert_fusions_to_vcf", "annotate_exon_numbers",
             "quantify_virus_expression",
             "extract_fusion_supporting_alignments", "draw_fusions"):
    importlib.import_module("arriba_tpu_torch.tools." + name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "arriba_tpu",
                                       "matplotlib"))
print(loaded)
"""
    env = dict(os.environ, ARRIBA_TPU_TORCH_DEVICE="cpu")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                            env=env, capture_output=True, text=True,
                            timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout.strip() == "[]"
