from setuptools import Extension, find_packages, setup

setup(
    name="pyfastani-tpu",
    version="0.1.0",
    description="TPU-native whole-genome ANI engine (FastANI method)",
    packages=find_packages(
        include=[
            "pyfastani_tpu",
            "pyfastani_tpu.*",
            "pyfastani_tpu_torch",
            "pyfastani_tpu_torch.*",
        ]
    ),
    package_data={
        "pyfastani_tpu": ["py.typed", "**/*.pyi"],
        # built at first use: the CUDA library and the host C extension
        "pyfastani_tpu_torch": ["py.typed", "**/*.pyi", "csrc/*.cu", "_native/fastamod.c"],
    },
    ext_modules=[
        Extension(
            "pyfastani_tpu._native._native",
            sources=["pyfastani_tpu/_native/fastamod.c"],
            extra_compile_args=["-O3", "-pthread"],
            extra_link_args=["-pthread"],
            optional=True,
        )
    ],
    python_requires=">=3.9",
    install_requires=["numpy"],
    extras_require={"tpu": ["jax"]},
)
