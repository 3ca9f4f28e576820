"""Framework exception hierarchy.

Equivalent of the reference error module (reference:
``veles/error.py:38-56``): the same taxonomy — generic framework error, data
format error, internal invariant violation ("Bug"), and master/slave protocol
error — expressed as plain Python exceptions.
"""


class VelesError(Exception):
    """Base class for all framework errors."""


class BadFormatError(VelesError):
    """Raised when input data has an unexpected format or shape."""


class Bug(VelesError):
    """An internal invariant was violated: this is a framework bug."""


class MasterSlaveCommunicationError(VelesError):
    """Fleet-mode protocol violation between master and slave."""


class NoMoreJobsError(VelesError):
    """Raised by job generation when an epoch/run has been exhausted.

    Mirrors ``workflow.py:78`` (NoMoreJobs) in the reference.
    """


class AttributeMissingError(VelesError):
    """A unit's demanded attribute was not linked before initialize().

    Mirrors the demand() check in reference ``units.py:682-699``.
    """

    def __init__(self, unit, attrs):
        self.unit = unit
        self.attrs = tuple(attrs)
        super().__init__(
            "%s is missing demanded attribute(s): %s"
            % (unit, ", ".join(self.attrs)))
