"""Self-materializing dotted configuration tree.

The port's copy of ``veles_tpu/core/config.py`` (reference
``veles/config.py:52-290``): a ``Config`` node materializes child nodes on
attribute access so workflow config files can write
``root.mnist.learning_rate = 0.01`` without declaring intermediate nodes.
Supports nested ``update()``, ``protect()``-ed read-only keys and pretty
printing.

The port's defaults are the training engine's knobs, the mesh's axes
and the reduce tier, the dashboards' switches, the serving survival
layer's (``root.common.serve``) and the observe plane's serving hooks'
(``root.common.observe``). It reads no site overrides and
keeps no cache directories: nothing here touches a file.
"""

import os
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

#: the run-time files' home: $VELES_TPU_HOME, else the port's git-ignored
#: build directory
_HOME = (os.path.expanduser(os.environ["VELES_TPU_HOME"])
         if os.environ.get("VELES_TPU_HOME")
         else os.path.join(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))), "_build"))

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
        # the port's own tuning cache (ops/gemm.py): verdicts keyed by
        # the card, under the git-ignored build directory
        "pallas_autotune_cache": os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "_build", "pallas_tuning.json"),
    },
    # where run-time files go: the flight recorder's black boxes under
    # "run" (observe/flight.py), a daemonized run's daemon.log under
    # "cache" (-b). VELES_TPU_HOME relocates them, as in the JAX package
    # (its run dir is $VELES_TPU_HOME/run); without it the port keeps
    # them in its git-ignored build directory
    "dirs": {
        "run": os.path.join(_HOME, "run"),
        "cache": os.path.join(_HOME, "cache"),
    },
    # the logical mesh's axes (parallel/mesh.py): all ones is one
    # process on one device; any other size (--mesh data=2) makes the
    # launcher build the mesh into the workflow. Only the data axis is
    # ported (ROADMAP A8 (b) brings the others). The world's backend:
    # None is NCCL on a card and gloo on the CPU; ranks that share one
    # card name "gloo" (NCCL takes one rank per device)
    "mesh": {
        "axes": {"data": 1, "model": 1, "seq": 1, "expert": 1, "pipe": 1},
        "backend": None,
    },
    # the data-parallel gradient reduce's wire tier (parallel/mapreduce.py,
    # --fleet-reduce): "f32", "bf16" or "int8"
    "fleet": {"reduce": "f32"},
    # the dashboards: plotting (plotting/) and the web status notifier
    # (web_status.py, off until enabled)
    "disable": {"plotting": False, "snapshotting": False},
    "web": {"enabled": False, "host": "localhost", "port": 8090,
            "notification_interval": 1.0},
    "trace": {"run": False},
    "timings": False,
    # the observe plane's serving hooks: SLO objectives (None: no engine;
    # a dict or the --serve-slo "name=value,..." string), the metric
    # history (None: on at its defaults wherever /metrics is mounted;
    # "off" disables it; the --serve-history "key=value,..." string tunes
    # it) and memscope's leak threshold and byte budget (the budget is
    # read only where the device reports no limit)
    "observe": {
        "slo": None,
        "history": None,
        "memscope": {"leak_min_bytes": 1 << 20, "limit_bytes": None},
    },
    # the serving survival layer (the JAX package's config.py:197-208):
    # the admission bound (max_queue <= 0 disables load shedding), the
    # default per-request deadline, the breaker's rebuild backoff, the
    # KV tier GenerateAPI serves (paged pool or dense slab, and the
    # pool's geometry; None sizes it from the decoder's defaults) and
    # the serving chaos harness (serving_chaos.py), off by default. The
    # JAX package's paged_kernel knob has no counterpart: on the card
    # the paged pool always attends through K1 or K3.
    "serve": {
        "max_queue": 64,
        "deadline": 300.0,
        "rebuild_backoff": 0.5,
        "rebuild_backoff_max": 30.0,
        "paged": False,
        "page_size": None,
        "pool_pages": None,
        # every fault at probability 0 and no profile: from_config()
        # builds no monkey until a knob is set
        "chaos": {"seed": 1, "step_fail": 0.0, "step_fail_max": None,
                  "slow_step": 0.0, "slow_step_ms": 20.0,
                  "disconnect": 0.0, "garbage_body": 0.0,
                  "oversize_body": 0.0},
    },
})
