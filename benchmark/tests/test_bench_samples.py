"""The generator: deterministic per seed and per checkout cache, and its
BAM read by the port exactly as a SAM of the same records."""

import contextlib
import gzip
import io
import struct

import numpy as np
import pytest

from benchmark import harness, samples
from benchmark.tests import tiny

LAYOUT = dict(host_contigs=24, genes_per_contig=4, exons_per_gene=10,
              gene_spacing=3000, exon_pitch=250, exon_length=100,
              contig_margin=5000, viral_length=200000, read_length=150,
              background_pairs=3000, bam_compression_level=1)


def make(tmp_path, seed, **traffic):
    return samples.make(LAYOUT, dict(tiny.TRAFFIC, **traffic), seed,
                        tmp_path, threads=2)


def test_bench_sample_is_the_same_for_a_seed(tmp_path):
    bg, planted, written = make(tmp_path, 2 ** 31 + 7)
    first = bg.sample.read_bytes()
    marker = (bg.directory / "complete.json").stat().st_mtime_ns
    again, planted2, written2 = make(tmp_path, 2 ** 31 + 7)
    assert again.sample.read_bytes() == first
    assert (bg.directory / "complete.json").stat().st_mtime_ns == marker
    assert written == written2 and planted.fragments == planted2.fragments
    other, _, _ = make(tmp_path, 5)
    text = other.sample.read_bytes()
    assert text[:bg.prefix_bytes] == first[:bg.prefix_bytes]
    assert text != first


def test_bench_sample_counts_what_it_planted(tmp_path):
    _, planted, _ = make(tmp_path, 9, keep_every=3)
    sizes = samples.support_sizes(tiny.TRAFFIC)
    d_sizes = np.round(sizes * 0.2).astype(int)
    kept = sum(-(-n // 3) for n in sizes) + -(-40 // 3) + -(-40 // 3)
    kept_d = sum(-(-n // 3) for n in d_sizes) + -(-20 // 3)
    assert len(planted.split) == kept and len(planted.discordant) == kept_d
    assert planted.fragments == kept + kept_d + 8
    # every junction keeps split fragments, with its own genes, on two
    # contigs and one strand
    assert (np.bincount(planted.split.junction[planted.split.junction >= 0],
                        minlength=4) >= 20 // 3).all()
    genes = np.concatenate([planted.gene1, planted.gene2])
    assert len(np.unique(genes)) == len(genes)
    assert (planted.contig1 != planted.contig2).all()
    assert (planted.gene1 % 2 == planted.gene2 % 2).all()
    assert len(np.unique(planted.split.fid)) == len(planted.split)


def bam_to_sam(data: bytes) -> str:
    """SAM text of a BAM's records (the tags this generator writes)."""
    raw = gzip.decompress(data)
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8:8 + l_text].decode()
    at = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, at)[0]
    at += 4
    names = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, at)[0]
        names.append(raw[at + 4:at + 3 + l_name].decode())
        at += 8 + l_name
    lines = [text.rstrip("\n")]
    nt16 = "=ACMGRSVTWYHKDBN"
    while at < len(raw):
        size, ref, pos, l_name, _, _, n_cigar, flag, l_seq, mref, mpos, \
            tlen = struct.unpack_from("<iiiBBHHHiiii", raw, at)
        body = at + 36
        name = raw[body:body + l_name - 1].decode()
        body += l_name
        cigar = "".join(f"{c >> 4}{'MIDNSHP=X'[c & 15]}" for c in
                        struct.unpack_from(f"<{n_cigar}I", raw, body))
        body += 4 * n_cigar
        packed = raw[body:body + (l_seq + 1) // 2]
        seq = "".join(nt16[b >> 4] + nt16[b & 15] for b in packed)[:l_seq]
        body += (l_seq + 1) // 2 + l_seq
        tags = []
        end = at + 4 + size
        while body < end:
            tag, kind = raw[body:body + 2].decode(), chr(raw[body + 2])
            if kind == "C":
                tags.append(f"{tag}:i:{raw[body + 3]}")
                body += 4
            else:
                stop = raw.index(b"\0", body + 3)
                tags.append(f"{tag}:Z:{raw[body + 3:stop].decode()}")
                body = stop + 1
        mate = "=" if mref == ref else (names[mref] if mref >= 0 else "*")
        lines.append("\t".join([name, str(flag), names[ref], str(pos + 1),
                                "60", cigar, mate, str(mpos + 1), str(tlen),
                                seq, "*"] + tags))
        at = end
    return "\n".join(lines) + "\n"


def port_outputs(bg, alignments, out_dir, monkeypatch) -> tuple:
    from arriba_tpu_torch import cli

    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    out_dir.mkdir()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        status = cli.main(["-x", str(alignments)] + bg.cli_files() + [
            "-s", "no", "-@", "2", "-o", str(out_dir / "f.tsv"),
            "-O", str(out_dir / "d.tsv")])
    assert status == 0
    counters = harness.COUNTER.findall(stdout.getvalue())
    return ((out_dir / "f.tsv").read_bytes(),
            (out_dir / "d.tsv").read_bytes(), counters)


def test_bench_bam_and_sam_give_the_same_outputs(tmp_path, monkeypatch):
    bg, planted, _ = make(tmp_path, 123)
    sam = tmp_path / "sample.sam"
    sam.write_text(bam_to_sam(bg.sample.read_bytes()))
    from_bam = port_outputs(bg, bg.sample, tmp_path / "bam", monkeypatch)
    from_sam = port_outputs(bg, sam, tmp_path / "sam", monkeypatch)
    assert from_bam == from_sam
    assert from_bam[0].count(b"\n") > 1
    assert any("(total=" in c for c in from_bam[2])


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
def test_bench_large_and_small_seeds_plant(seed):
    layout = samples.Layout.of(LAYOUT)
    planted = samples.plant(layout, tiny.TRAFFIC, seed)
    sizes = samples.support_sizes(tiny.TRAFFIC)
    assert planted.fragments == (sizes.sum() + 80 + np.round(
        sizes * 0.2).astype(int).sum() + 20 + 8)
