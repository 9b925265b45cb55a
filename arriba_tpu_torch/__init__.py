"""arriba_tpu_torch — the PyTorch / CUDA port of arriba_tpu.

The same gene-fusion detection engine, flag for flag and byte for byte:
``python -m arriba_tpu_torch`` writes the fusions.tsv and
fusions.discarded.tsv that ``python -m arriba_tpu`` writes. The host modules
(io/, ingest/, annotation/, most of filters/ and output/) are copies of the
JAX package's; the native C++ engine is built from the same ``native/``
sources. The offloaded stages run on an NVIDIA GPU through PyTorch and
hand-written CUDA kernels (``kernels/``), selected by
ARRIBA_TPU_TORCH_DEVICE=cuda|cpu|off (``device.py``).

Layer map:
  constants / contigs            core data model + filter registry
  io/                            FASTA, GTF, SAM/BAM/CRAM decoding
  annotation/                    gene/exon tables + interval index
  ingest/                        chimeric-alignment extraction + read stats
  filters/                       the ~30-stage filter/recovery cascade
  fusions_finder.py              breakpoint clustering
  ops/                           PyTorch device ops (plain versions + kernel
                                 dispatch for CUDA tensors)
  kernels/                       CUDA C++ sources, nvcc build, ctypes binding
  output/                        consensus assembly, peptides, TSV writer
  pipeline.py                    the orchestrator (reference: arriba.cpp:main)
"""

from . import _native_build

__version__ = "0.1.0"

_native_build.engine()  # build the engine now, or warn and run without it
