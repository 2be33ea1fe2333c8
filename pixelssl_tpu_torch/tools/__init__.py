"""Entry points beside training (counterparts of the JAX repository's
``tools/``): ``python -m pixelssl_tpu_torch.tools.infer_bench`` and
``python -m pixelssl_tpu_torch.tools.export_serving``."""
