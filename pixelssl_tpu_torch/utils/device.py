"""Device selection shared by the port's entry points."""

import torch


def resolve(device='cuda'):
    """``torch.device`` for an entry point's ``device`` argument.

    The port runs on the card unless the caller asks for the CPU: a CUDA
    device on a host without CUDA raises instead of silently running the
    CPU versions of the kernels.
    """
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available on this host; pass '
                           "device='cpu' to run the port on the CPU")
    return device
