"""Device resolution for every entry point of the port.

``device=None`` means the card. The port never carries on quietly on
the CPU: a caller without a CUDA device gets an error unless it asks
for ``device="cpu"`` itself (the CPU tests do)."""

import torch


def resolve_device(device=None):
    """Return the ``torch.device`` an entry point runs on: ``"cuda"``
    when ``device`` is None. Raises RuntimeError for a CUDA device on
    a host where ``torch.cuda.is_available()`` is false."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r"
                         % (device,))
    return device


def tree_to(tree, device, dtype=None):
    """Move a parameter tree (dicts / lists of tensors) to ``device``;
    floating leaves are cast to ``dtype`` when one is given, except the
    int8 tier's f32 ``scale`` leaves. A no-op for leaves already
    there."""
    if isinstance(tree, dict):
        return {key: (val.to(device) if key == "scale"
                      else tree_to(val, device, dtype))
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(val, device, dtype) for val in tree)
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)
