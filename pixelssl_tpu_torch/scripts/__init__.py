"""Experiment scripts of the port: each builds an ``OrderedDict`` config
and calls ``pixelssl_tpu_torch.run_script`` (see ``_common.py``)."""
