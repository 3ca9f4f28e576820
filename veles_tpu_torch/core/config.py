"""Self-materializing dotted configuration tree.

The port's copy of ``veles_tpu/core/config.py`` (reference
``veles/config.py:52-290``): a ``Config`` node materializes child nodes on
attribute access so workflow config files can write
``root.mnist.learning_rate = 0.01`` without declaring intermediate nodes.
Supports nested ``update()``, ``protect()``-ed read-only keys and pretty
printing.

The port's defaults are the training engine's knobs only. It reads no
site overrides and keeps no cache directories: nothing here touches a
file.
"""

import pprint

from veles_tpu_torch.core.errors import VelesError


class ConfigError(VelesError):
    pass


_PROTECTED = "_protected_"
_NAME = "_name_"


class Config:
    """A node in the configuration tree (reference ``config.py:52``)."""

    def __init__(self, path):
        object.__setattr__(self, _NAME, path)
        object.__setattr__(self, _PROTECTED, set())

    # -- materialization ----------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        child = Config("%s.%s" % (object.__getattribute__(self, _NAME), name))
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name, value):
        if name in object.__getattribute__(self, _PROTECTED):
            raise ConfigError(
                "Config key %s.%s is protected" % (self.__path__, name))
        object.__setattr__(self, name, value)

    # -- public API ---------------------------------------------------------
    @property
    def __path__(self):
        return object.__getattribute__(self, _NAME)

    def update(self, value=None, **kwargs):
        """Deep-merge a nested dict (or kwargs) into this subtree
        (reference ``config.py:156-176``)."""
        if value is None:
            value = kwargs
        if isinstance(value, Config):
            value = value.__content__()
        if not isinstance(value, dict):
            raise ConfigError(
                "Can only update %s from a dict, got %r"
                % (self.__path__, value))
        for key, val in value.items():
            if isinstance(val, dict):
                try:
                    node = object.__getattribute__(self, key)
                except AttributeError:
                    node = None
                if not isinstance(node, Config):
                    # a leaf is being deepened into a subtree: replace it
                    node = Config("%s.%s" % (self.__path__, key))
                    setattr(self, key, node)
                node.update(val)
            else:
                setattr(self, key, val)
        return self

    def protect(self, *names):
        """Make keys read-only (reference ``config.py`` protect())."""
        object.__getattribute__(self, _PROTECTED).update(names)

    def get(self, name, default=None):
        """Return the value of ``name`` without materializing it."""
        try:
            value = object.__getattribute__(self, name)
        except AttributeError:
            return default
        if isinstance(value, Config):
            return default
        return value

    def __contains__(self, name):
        try:
            return not isinstance(object.__getattribute__(self, name), Config)
        except AttributeError:
            return False

    def __content__(self):
        result = {}
        for key, value in vars(self).items():
            if key in (_NAME, _PROTECTED):
                continue
            if isinstance(value, Config):
                result[key] = value.__content__()
            else:
                result[key] = value
        return result

    def print_(self, stream=None):
        pprint.pprint({self.__path__: self.__content__()}, stream=stream)

    def __repr__(self):
        return "<Config %s: %s>" % (
            self.__path__, pprint.pformat(self.__content__()))


def validate_kwargs(caller, **kwargs):
    """Warn about Config nodes leaking in as kwargs values
    (reference ``config.py:164``): an unset config path materializes as a
    Config instance rather than a value, which is almost always a typo."""
    for name, value in kwargs.items():
        if isinstance(value, Config):
            raise ConfigError(
                "%s: keyword %r is an unset config node %s — probably a typo "
                "in your config file" % (caller, name, value.__path__))


#: The global configuration root, like reference ``config.py:151``.
root = Config("root")

# -- engine defaults (the JAX package's, config.py:160-176) -----------------
root.common.update({
    "engine": {
        # compute dtype policy: level 0 runs the dense products on
        # bfloat16 operands with float32 accumulation; params stay f32
        "compute_dtype": "bfloat16",
        # precision levels mirror reference config.py:244-247: 0 - bf16
        # operands, 1 and 2 - float32 operands (the port computes both
        # in true f32, never TF32)
        "precision_level": 0,
        # the hand-written GEMM kernels (ops/gemm.py, K5 and K6) are
        # opt-in on the train path, as in the JAX package: both knobs on
        # put every eligible dense layer on the fused dense kernel
        "use_pallas": False,
        "pallas_epilogue": False,
    },
    "trace": {"run": False},
    "timings": False,
})
