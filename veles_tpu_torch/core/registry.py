"""Class registries: unit registry with kwargs typo-checking, name→class maps.

Re-design of reference ``veles/unit_registry.py`` and
``veles/mapped_object_registry.py``. The reference extracts accepted kwargs by
*bytecode-scanning* every ``__init__`` (``unit_registry.py:80-120``); here the
same typo guard is built idiomatically on ``inspect.signature`` walking the
MRO, with Damerau-Levenshtein suggestions for misspelled keyword arguments.
"""

import inspect


def damerau_levenshtein(a, b):
    """Edit distance with transpositions, for kwargs misprint suggestions
    (reference ``unit_registry.py`` misprint warnings)."""
    la, lb = len(a), len(b)
    if not la:
        return lb
    if not lb:
        return la
    prev2 = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (i > 1 and j > 1 and a[i - 1] == b[j - 2]
                    and a[i - 2] == b[j - 1]):
                cur[j] = min(cur[j], prev2[j - 2] + cost)
        prev2, prev = prev, cur
    return prev[lb]


def collect_kwattrs(cls):
    """Union of keyword parameter names across the MRO's ``__init__``s."""
    kwattrs = set()
    var_kw_only_everywhere = True
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        try:
            sig = inspect.signature(init)
        except (TypeError, ValueError):
            continue
        for name, param in sig.parameters.items():
            if name == "self":
                continue
            if param.kind in (param.POSITIONAL_OR_KEYWORD,
                              param.KEYWORD_ONLY):
                kwattrs.add(name)
                var_kw_only_everywhere = False
    return kwattrs, var_kw_only_everywhere


class UnitRegistry(type):
    """Metaclass recording every Unit subclass (reference
    ``unit_registry.py:50``). Populates ``cls.KWATTRS`` for typo checks and
    registers non-hidden units for the CLI/forge/web catalogs."""

    units = set()

    #: kwargs consumed via kwargs.pop()/get() in Unit.__init__ rather than
    #: declared in a signature
    BASE_KWATTRS = frozenset(
        {"name", "view_group", "timings", "logger_name", "result_file"})

    def __init__(cls, name, bases, clsdict):
        super().__init__(name, bases, clsdict)
        if not clsdict.get("hide_from_registry", False):
            UnitRegistry.units.add(cls)
        kwattrs, _ = collect_kwattrs(cls)
        cls.KWATTRS = kwattrs | UnitRegistry.BASE_KWATTRS

    def check_kwargs(cls, logger, **kwargs):
        """Warn on kwargs no ``__init__`` in the MRO accepts, suggesting the
        nearest real name."""
        known = cls.KWATTRS
        for kw in kwargs:
            if kw in known:
                continue
            best, bestd = None, 3
            for cand in known:
                d = damerau_levenshtein(kw, cand)
                if d < bestd:
                    best, bestd = cand, d
            if best is not None:
                logger.warning(
                    "%s: unknown keyword argument %r — did you mean %r?",
                    cls.__name__, kw, best)
            else:
                logger.warning(
                    "%s: unknown keyword argument %r", cls.__name__, kw)


class MappedObjectsRegistry(type):
    """Name→class registry metaclass (reference
    ``mapped_object_registry.py``): subclasses with a ``MAPPING`` name get
    recorded in the base registry's ``mapping`` dict. Used for loaders,
    normalizers, snapshotters, publisher backends, optimizers."""

    registries = {}

    def __init__(cls, name, bases, clsdict):
        super().__init__(name, bases, clsdict)
        base_key = getattr(cls, "REGISTRY", None)
        mapping = clsdict.get("MAPPING")
        if base_key is None or mapping is None:
            return
        MappedObjectsRegistry.registries.setdefault(base_key, {})[
            mapping] = cls

    @classmethod
    def get_mapping(mcs, registry):
        return mcs.registries.setdefault(registry, {})


class CommandLineArgumentsRegistry(type):
    """Collects per-class ``init_parser`` statics so every component
    contributes its flags to the single CLI (reference
    ``cmdline.py:61-84``)."""

    classes = []

    def __init__(cls, name, bases, clsdict):
        super().__init__(name, bases, clsdict)
        if "init_parser" in clsdict:
            CommandLineArgumentsRegistry.classes.append(cls)

    @classmethod
    def apply_all(mcs, parser):
        for cls in mcs.classes:
            parser = cls.init_parser(parser=parser) or parser
        return parser


class UnitCommandLineArgumentsRegistry(UnitRegistry,
                                       CommandLineArgumentsRegistry):
    """Units that also register CLI flags (reference
    ``unit_registry.py`` composition)."""
