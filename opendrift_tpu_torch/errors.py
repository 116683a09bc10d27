"""Exception taxonomy.

Mirrors the reference's error surface (reference: opendrift/errors.py:1-15) so user
code catching these by name behaves identically.
"""


class WrongMode(Exception):
    """An operation was attempted in the wrong simulation mode."""

    def __init__(self, expected_mode, real_mode, msg=None):
        if msg is None:
            msg = f"Expected mode {expected_mode}, but simulation is in {real_mode}"
        super().__init__(msg)
        self.expected_mode = expected_mode
        self.real_mode = real_mode


class NotCoveredError(Exception):
    """Requested positions/time are not covered by any reader."""


class OutsideSpatialCoverageError(NotCoveredError):
    """Requested positions are outside a reader's spatial coverage."""


class OutsideTemporalCoverageError(NotCoveredError):
    """Requested time is outside a reader's temporal coverage."""


class VariableNotCoveredError(NotCoveredError):
    """A required variable is not provided by any reader."""
