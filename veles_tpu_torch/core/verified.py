"""Interface verification for units.

Reference ``veles/verified.py:36-66`` ran zope ``verifyObject`` +
``verifyClass`` on every unit at construction (IUnit, IDistributable,
ILoader...). The re-design keeps the capability without the zope
dependency: an interface is a contract dict of method names →
(min_positional_args) that :func:`verify_interface` checks structurally —
the method exists, is callable, and accepts the required arity — raising
one descriptive error instead of a far-away AttributeError/TypeError at
runtime.

Workflow.initialize verifies IUNIT always and IDISTRIBUTABLE when the run
is not standalone (the reference skipped distributed verification in
standalone mode too, ``workflow.py:299-345``).
"""

import inspect

from veles_tpu_torch.core.errors import VelesError


class InterfaceError(VelesError):
    pass


#: method -> minimum positional parameters AFTER self
IUNIT = {"initialize": 0, "run": 0, "stop": 0}

#: arities are the CALL-SITE arg counts (workflow.py fleet paths), so an
#: implementation missing the slave parameter fails HERE, not mid-update
IDISTRIBUTABLE = {
    "generate_data_for_master": 0,
    "generate_data_for_slave": 1,   # (slave)
    "apply_data_from_master": 1,    # (data)
    "apply_data_from_slave": 2,     # (data, slave)
    "drop_slave": 1,                # (slave)
}

ILOADER = {"load_data": 0, "create_minibatch_data": 0,
           "fill_minibatch": 2}


def _accepts(fn, n_args):
    """True when ``fn(*n_args values)`` is a valid call: capacity covers
    n_args, no MORE than n_args are required, and no default-less
    keyword-only parameters exist (call sites pass positionally)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True  # builtins/C funcs: cannot introspect, trust them
    capacity = 0
    required = 0
    has_var = False
    for param in sig.parameters.values():
        if param.kind in (param.POSITIONAL_ONLY,
                          param.POSITIONAL_OR_KEYWORD):
            capacity += 1
            if param.default is param.empty:
                required += 1
        elif param.kind == param.VAR_POSITIONAL:
            has_var = True
        elif param.kind == param.KEYWORD_ONLY \
                and param.default is param.empty:
            return False
    return (has_var or capacity >= n_args) and required <= n_args


def verify_interface(obj, interface, name="interface"):
    """Raise InterfaceError listing every contract violation at once."""
    problems = []
    for method, n_args in interface.items():
        fn = getattr(obj, method, None)
        if fn is None:
            problems.append("missing method %s()" % method)
        elif not callable(fn):
            problems.append("%s is not callable" % method)
        elif not _accepts(fn, n_args):
            problems.append("%s() is not callable with %d argument(s)"
                            % (method, n_args))
    if problems:
        raise InterfaceError(
            "%s does not implement %s: %s"
            % (getattr(obj, "name", type(obj).__name__), name,
               "; ".join(problems)))
