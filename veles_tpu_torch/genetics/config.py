"""Gene declaration in config trees (reference ``genetics/config.py``),
the port of ``veles_tpu/genetics/config.py``.

A config value of ``Range(min, max)`` marks a tunable; ``process_config``
walks a Config subtree collecting (dotted-path, Range) genes, and
``fix_config`` strips Ranges back to plain values for ordinary runs.
"""

from veles_tpu_torch.core.config import Config


class Range:
    """A tunable config value (reference ``genetics/config.py:110``)."""

    def __init__(self, default, min_value=None, max_value=None):
        if min_value is None and max_value is None:
            # Range(min, max) two-arg shorthand
            raise TypeError("Range needs (default, min, max) or "
                            "(default, min_value=, max_value=)")
        self.default = default
        self.min_value = min_value
        self.max_value = max_value
        self.is_integer = (isinstance(default, int)
                           and isinstance(min_value, int)
                           and isinstance(max_value, int))

    def clip(self, value):
        value = max(self.min_value, min(self.max_value, value))
        return int(round(value)) if self.is_integer else value

    def __repr__(self):
        return "Range(%r, %r, %r)" % (self.default, self.min_value,
                                      self.max_value)


def process_config(node, prefix="root"):
    """Collect (dotted_path, Range) genes from a Config subtree
    (reference ``process_config``, ``genetics/config.py:130``)."""
    genes = []
    for key, value in vars(node).items():
        if key.startswith("_"):
            continue
        path = "%s.%s" % (prefix, key)
        if isinstance(value, Config):
            genes.extend(process_config(value, path))
        elif isinstance(value, Range):
            genes.append((path, value))
    return genes


def fix_config(node):
    """Replace every Range with its default (reference ``fix_config``,
    ``genetics/config.py:164``)."""
    for key, value in vars(node).items():
        if key.startswith("_"):
            continue
        if isinstance(value, Config):
            fix_config(value)
        elif isinstance(value, Range):
            setattr(node, key, value.default)
    return node
