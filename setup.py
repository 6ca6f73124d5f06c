import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Builds libscvid.so (the native video layer) before the Python
    package so ctypes finds it inside scanner_tpu/video/."""

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.check_call(["make", "-C", os.path.join(here, "cpp")])
        super().run()


setup(
    name="scanner_tpu",
    version="0.1.0",
    description=("TPU-native framework for efficient analysis of large "
                 "video datasets (scanner-research/scanner capabilities, "
                 "JAX/XLA execution)"),
    packages=find_packages(include=["scanner_tpu", "scanner_tpu.*",
                                    "scanner_tpu_torch",
                                    "scanner_tpu_torch.*"]),
    package_data={"scanner_tpu.video": ["libscvid.so"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "numpy", "msgpack", "cloudpickle",
        "grpcio",
        # item-file integrity: crc32c checksums (storage/items.py).
        # Load-bearing — without it writers fall back to zlib.crc32
        # (format version 3) and readers skip crc32c verification.
        "google-crc32c",
        # config.py falls back to tomli where stdlib tomllib is absent
        'tomli; python_version < "3.11"',
    ],
    entry_points={
        "console_scripts": [
            # repo-native static analysis (docs/static-analysis.md);
            # tools/scanner_check.py is the in-checkout equivalent
            "scanner-check=scanner_tpu.analysis.static.cli:main",
        ],
    },
    cmdclass={"build_py": BuildWithNative},
)
