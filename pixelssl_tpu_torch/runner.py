"""Argument parser of an experiment (counterpart of
``pixelssl_tpu/runner.py``; reference pixelssl/runner.py:12-41). The
script runner, the proxy and the data loaders are not ported yet."""

import argparse

from . import ssl_algorithm
from .nn import lrer, optimizer


def create_parser(ssl_algorithm_name):
    parser = argparse.ArgumentParser(description='PixelSSL on PyTorch/CUDA')
    optimizer.add_parser_arguments(parser)
    lrer.add_parser_arguments(parser)
    ssl_algorithm.get_module(ssl_algorithm_name).add_parser_arguments(parser)
    return parser
