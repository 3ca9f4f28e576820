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


def tree_leaves_with_path(tree, path=()):
    """``(path, leaf)`` for every tensor leaf of a parameter tree, in the
    order ``jax.tree_util.tree_flatten_with_path`` gives (dict keys
    sorted, lists and tuples in order); ``path`` is the tuple of keys and
    indices from the root."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in tree_leaves_with_path(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, val in enumerate(tree)
                for item in tree_leaves_with_path(val, path + (i,))]
    return [(path, tree)]


def keystr(path):
    """A leaf path as ``jax.tree_util.keystr`` writes it:
    ``[0]['blocks'][1]['wqkv']``."""
    return "".join("[%r]" % (key,) for key in path)


def tree_structure(tree):
    """A tree's structure without its leaves (dict keys sorted), equal
    for two trees exactly where JAX's treedefs are."""
    if isinstance(tree, dict):
        return ("dict", tuple((key, tree_structure(tree[key]))
                              for key in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(tree_structure(val) for val in tree))
    return "*"


def tree_rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves_with_path``
    order, from the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {key: tree_rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rebuild(val, leaves) for val in tree)
    return next(leaves)


def tree_replace(tree, path, leaf):
    """A copy of ``tree`` (containers only; leaves shared) with the leaf
    at ``path`` replaced by ``leaf``."""
    if not path:
        return leaf
    key, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return dict(tree, **{key: tree_replace(tree[key], rest, leaf)})
    items = list(tree)
    items[key] = tree_replace(items[key], rest, leaf)
    return type(tree)(items)
