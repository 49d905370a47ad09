"""Wheel build for the client/serving Python stack.

Role of the reference's packaging pipeline (SURVEY.md §2.4: CMake +
build_wheel.py producing generic and linux wheels, the linux one bundling
the shm C extensions and perf_analyzer). Here one setup.py builds:

- the pure-Python `client_tpu` package (clients, engine, servers, zoo) —
  the shared-memory data plane is pure Python (mmap), so the wheel stays
  platform-independent; the C shm library (libcshm) is a CMake target in
  native/ for non-Python consumers,
- the deprecation compat shims (tpuhttpclient, tpugrpcclient, ...),
- the PyTorch/CUDA port `client_tpu_torch` (needs torch; its CUDA kernel
  sources ship as package data and are compiled by nvcc at first use).

Usage: python setup.py bdist_wheel   (or: pip wheel .)
"""

from setuptools import find_packages, setup

setup(
    name="client-tpu",
    version="1.0.0",
    description=(
        "TPU-native inference client libraries and serving engine "
        "(KServe v2 protocol: HTTP, gRPC, shared-memory data planes)"
    ),
    packages=find_packages(include=["client_tpu", "client_tpu.*",
                                    "client_tpu_torch", "client_tpu_torch.*"]),
    py_modules=[
        "tpuhttpclient",
        "tpugrpcclient",
        "tpuclientutils",
        "tpushmutils",
    ],
    package_data={
        "client_tpu.protocol": ["protos/*.proto"],
        "client_tpu_torch": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=[
        "numpy>=1.22",
        "grpcio>=1.48",
        "protobuf>=3.20",
    ],
    extras_require={
        "engine": ["jax>=0.4"],
        "torch": ["torch>=2.1"],
    },
)
