from setuptools import find_packages, setup

setup(
    name="paddle_sparse_jax",
    version="0.1.0",
    description="Sparse linear-algebra framework for JAX (XLA + Pallas)",
    packages=find_packages(include=["paddle_sparse_jax*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
