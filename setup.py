"""Install helper (counterpart of reference setup.py)."""

from setuptools import find_packages, setup

exec(open('pixelssl_tpu/version.py').read())

setup(
    name='pixelssl-tpu',
    version=__version__,  # noqa: F821
    description='TPU-native toolbox for semi-supervised pixel-wise vision '
                'tasks (JAX/XLA/pallas rebuild of the PixelSSL capabilities)',
    license='MIT',
    packages=find_packages(include=['pixelssl_tpu', 'pixelssl_tpu.*',
                                    'pixelssl_tpu_torch',
                                    'pixelssl_tpu_torch.*']),
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy', 'pyyaml',
        'pillow',
    ],
)
