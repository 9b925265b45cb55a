"""Downstream utility tools — equivalents of the reference's scripts/
(convert_fusions_to_vcf.sh, annotate_exon_numbers.sh,
quantify_virus_expression.sh, extract_fusion-supporting_alignments.sh) and
draw_fusions.R, implemented natively so no samtools/awk toolchain is
required. Host-only: they touch no device and import matplotlib only when
draw_fusions renders. ``python -m arriba_tpu_torch.tools.<name>``."""
