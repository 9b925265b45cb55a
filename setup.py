"""Build configuration: the native data-loader extension."""

import os

from setuptools import Extension, setup

# libdeflate (when present) accelerates BGZF block decompression; the code
# falls back to zlib-only via __has_include when the header is absent
_LIBS = ["z"] + (["deflate"] if os.path.exists("/usr/include/libdeflate.h")
                 else [])

# profile-guided optimization: ARRIBA_TPU_PGO=gen builds an instrumented
# extension (run the workload, .gcda lands next to the objects), then
# ARRIBA_TPU_PGO=use rebuilds against the collected profile
_PGO = os.environ.get("ARRIBA_TPU_PGO", "")
_PGO_FLAGS = {"gen": ["-fprofile-generate"],
              "use": ["-fprofile-use", "-fprofile-correction",
                      "-Wno-missing-profile"]}.get(_PGO, [])

setup(
    name="arriba_tpu",
    version="0.1.0",
    packages=["arriba_tpu", "arriba_tpu.annotation", "arriba_tpu.filters",
              "arriba_tpu.ingest", "arriba_tpu.io", "arriba_tpu.ops",
              "arriba_tpu.output", "arriba_tpu.parallel", "arriba_tpu.tools",
              # the PyTorch / CUDA port; its kernels (kernels/csrc) are built
              # with nvcc at first use
              "arriba_tpu_torch", "arriba_tpu_torch.annotation",
              "arriba_tpu_torch.filters", "arriba_tpu_torch.ingest",
              "arriba_tpu_torch.io", "arriba_tpu_torch.kernels",
              "arriba_tpu_torch.ops", "arriba_tpu_torch.output",
              "arriba_tpu_torch.parallel", "arriba_tpu_torch.tools"],
    package_data={"arriba_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension("arriba_tpu._native",
                  sources=["native/ingest.cpp", "native/gtf.cpp", "native/realign.cpp",
                           "native/annotate.cpp", "native/filters.cpp",
                           "native/cascade.cpp", "native/fusions.cpp",
                           "native/event.cpp", "native/extract.cpp",
                           "native/codecs.cpp"],
                  extra_compile_args=["-O3", "-std=c++17"] + _PGO_FLAGS,
                  extra_link_args=list(_PGO_FLAGS), libraries=_LIBS),
        # the same engine under the port's name (PyInit__native loads under
        # either package)
        Extension("arriba_tpu_torch._native",
                  sources=["native/ingest.cpp", "native/gtf.cpp", "native/realign.cpp",
                           "native/annotate.cpp", "native/filters.cpp",
                           "native/cascade.cpp", "native/fusions.cpp",
                           "native/event.cpp", "native/extract.cpp",
                           "native/codecs.cpp"],
                  extra_compile_args=["-O3", "-std=c++17"] + _PGO_FLAGS,
                  extra_link_args=list(_PGO_FLAGS), libraries=_LIBS),
    ],
)
