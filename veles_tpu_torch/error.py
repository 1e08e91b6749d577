"""Framework error types of the port (the JAX package's ``error``
module)."""


class VelesError(Exception):
    """Base class for all framework errors."""


class Bug(VelesError):
    """Internal invariant violation, or a request for what is not
    ported yet."""


class BadFormatError(VelesError):
    """Malformed input data or configuration."""


class AlreadyExistsError(VelesError):
    """Attempt to register a duplicate object."""


class NotExistsError(VelesError):
    """Lookup of an unregistered object."""


class DeviceNotFoundError(VelesError):
    """Requested device is unavailable."""
