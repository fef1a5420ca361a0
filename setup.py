"""Build the optional native host extension.

    python setup.py build_ext --inplace

Pure-Python fallbacks exist for every native function, so the package
works without this build; the extension accelerates FASTA ingest and
`.cfrk` formatting (cfrk_tpu/io/native/fastaio.cpp).
"""

from setuptools import Extension, setup

setup(
    name="cfrk-tpu",
    version="0.1.0",
    packages=[
        "cfrk_tpu",
        "cfrk_tpu.io",
        "cfrk_tpu.io.native",
        "cfrk_tpu.ops",
        "cfrk_tpu.parallel",
        "cfrk_tpu.pipeline",
        "cfrk_tpu.runtime",
    ],
    ext_modules=[
        Extension(
            "cfrk_tpu.io.native._fastaio",
            sources=["cfrk_tpu/io/native/fastaio.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
    entry_points={
        "console_scripts": ["cfrk-tpu = cfrk_tpu.cli:main"],
    },
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
)
