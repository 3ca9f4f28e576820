"""Mutable booleans and attribute links — the control/data-link primitives.

Re-design of reference ``veles/mutable.py``:

- ``Bool`` (reference ``mutable.py:44-216``): a mutable boolean that composes
  with ``| & ^ ~`` into lazy expression DAGs. Units gate on these (e.g.
  ``decision.gate_block = ~loader.complete``): the expression re-evaluates on
  every truth test, so flipping the leaf flips every derived gate. ``b <<=
  value`` assigns in place; ``on_true``/``on_false`` callbacks fire on edge
  transitions. Unlike the reference (which marshals closure bytecode to make
  expressions picklable), expressions here are (operator-name, operands)
  tuples, which pickle naturally.
- ``LinkableAttribute`` (reference ``mutable.py:219-357``): pointer semantics
  for unit data links. ``link_attrs`` on immutable values (ints, floats,
  strings) cannot share by reference, so a descriptor is installed on the
  consumer's class that forwards reads (and optionally writes) to
  ``(provider, attr_name)``.
"""

import operator

from veles_tpu_torch.core.errors import VelesError

_OPS = {
    "or": operator.or_, "and": operator.and_,
    "xor": operator.xor, "not": None,
}


class Bool:
    """Mutable, composable boolean (reference ``mutable.py:44``)."""

    __slots__ = ("_value", "_op", "_operands", "on_true", "on_false")

    def __init__(self, value=False):
        if isinstance(value, Bool):
            value = bool(value)
        self._value = bool(value)
        self._op = None
        self._operands = ()
        self.on_true = None
        self.on_false = None

    @classmethod
    def _expr(cls, op, *operands):
        b = cls()
        b._op = op
        b._operands = operands
        return b

    @property
    def expr(self):
        """True if this Bool is a derived expression, not a leaf."""
        return self._op is not None

    def __bool__(self):
        if self._op is None:
            return self._value
        if self._op == "not":
            return not bool(self._operands[0])
        fn = _OPS[self._op]
        result = bool(self._operands[0])
        for x in self._operands[1:]:
            result = fn(result, bool(x))
        return result

    # -- in-place assignment: b <<= value (reference mutable.py:90) ---------
    def __ilshift__(self, value):
        if self._op is not None:
            raise VelesError("Cannot assign to a derived Bool expression")
        old = self._value
        self._value = bool(value)
        if self._value and not old and self.on_true is not None:
            self.on_true()
        elif not self._value and old and self.on_false is not None:
            self.on_false()
        return self

    def set(self, value=True):
        """Explicit assignment — equivalent to ``b <<= value`` without the
        augmented-assignment scoping gotcha in closures."""
        return self.__ilshift__(value)

    def unset(self):
        return self.__ilshift__(False)

    # -- lazy composition (reference mutable.py:77-85) ----------------------
    def __or__(self, other):
        return Bool._expr("or", self, _coerce(other))

    __ror__ = __or__

    def __and__(self, other):
        return Bool._expr("and", self, _coerce(other))

    __rand__ = __and__

    def __xor__(self, other):
        return Bool._expr("xor", self, _coerce(other))

    __rxor__ = __xor__

    def __invert__(self):
        return Bool._expr("not", self)

    def __eq__(self, other):
        if isinstance(other, (Bool, bool, int)):
            return bool(self) == bool(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return id(self)

    def __repr__(self):
        if self._op is None:
            return "<Bool %s>" % self._value
        return "<Bool expr %s=%s>" % (self._op, bool(self))

    def __getstate__(self):
        # triggers are live-object callbacks; they are rebound on unpickle
        # by whoever registered them (cf. reference marshal dance).
        return self._value, self._op, self._operands

    def __setstate__(self, state):
        self._value, self._op, self._operands = state
        self.on_true = None
        self.on_false = None


def _coerce(value):
    return value if isinstance(value, Bool) else Bool(value)


class LinkableAttribute:
    """Descriptor forwarding an attribute to ``(provider, attr)``
    (reference ``mutable.py:219-357``).

    Installed on the *consumer instance's class* lazily; per-instance targets
    live in the instance ``__dict__`` under a private key, so distinct
    instances of the same class can link to different providers (or not be
    linked at all, in which case plain attribute storage applies).
    """

    _MISSING = object()

    def __init__(self, name, class_default=_MISSING):
        self.name = name
        # no trailing underscore: link targets must SURVIVE pickling (the
        # provider is part of the same pickled workflow graph), or resumed
        # snapshots would silently lose every data link
        self.storage = "_linkable_%s" % name
        # the class attribute this descriptor shadowed, if any, so unlinked
        # instances keep seeing their class-level default
        self.class_default = class_default

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        target = obj.__dict__.get(self.storage)
        if target is None:
            try:
                return obj.__dict__[self.name]
            except KeyError:
                if self.class_default is not self._MISSING:
                    return self.class_default
                raise AttributeError(self.name) from None
        provider, attr = target[:2]
        return getattr(provider, attr)

    def __set__(self, obj, value):
        target = obj.__dict__.get(self.storage)
        if target is None:
            obj.__dict__[self.name] = value
            return
        provider, attr, two_way = target
        if two_way:
            setattr(provider, attr, value)
        else:
            # breaking the link by direct assignment mirrors the reference's
            # "assignment overwrites the link" semantics
            obj.__dict__[self.storage] = None
            obj.__dict__[self.name] = value


def link(consumer, name, provider, provider_attr=None, two_way=False):
    """Create/refresh a link so ``consumer.name`` reads
    ``provider.provider_attr`` (reference ``mutable.py:353``)."""
    provider_attr = provider_attr or name
    cls = type(consumer)
    descr = cls.__dict__.get(name)
    if not isinstance(descr, LinkableAttribute):
        if any(isinstance(getattr(base, name, None), property)
               for base in cls.__mro__):
            raise VelesError(
                "Cannot install a link over property %s.%s"
                % (cls.__name__, name))
        shadowed = getattr(cls, name, LinkableAttribute._MISSING)
        if isinstance(shadowed, LinkableAttribute):  # inherited descriptor
            shadowed = shadowed.class_default
        descr = LinkableAttribute(name, class_default=shadowed)
        setattr(cls, name, descr)
    consumer.__dict__[descr.storage] = (provider, provider_attr, two_way)


def unlink(consumer, name):
    """Detach a link, snapshotting the current value locally."""
    cls = type(consumer)
    descr = cls.__dict__.get(name)
    if isinstance(descr, LinkableAttribute):
        target = consumer.__dict__.get(descr.storage)
        if target is not None:
            value = getattr(consumer, name)
            consumer.__dict__[descr.storage] = None
            consumer.__dict__[name] = value
