"""Exception for versioned on-disk artifacts (the reference's
``util/errors.py``). A loader names the file, the version it found and
the one it expected, so a stale artifact says how to regenerate it."""
from __future__ import annotations


class ArtifactVersionError(ValueError):
    """A persisted artifact has the wrong version or a broken schema.
    Subclasses :class:`ValueError`, so ``except ValueError`` guards treat
    a stale artifact as "no artifact"."""

    def __init__(self, path: str, found, expected, *, kind: str = "artifact",
                 detail: str = "") -> None:
        self.path = path
        self.found = found
        self.expected = expected
        self.kind = kind
        msg = (f"{kind} {path!r}: found version {found!r}, expected "
               f"{expected!r}")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
