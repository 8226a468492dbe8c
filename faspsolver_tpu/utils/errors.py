"""Error type carrying the reference status-code vocabulary.

Reference: base/src/AuxMessage.c fasp_chkerr aborts with a code + location;
this framework raises a typed exception instead so callers can recover
(e.g. AMG-setup-failure fallback to safeguarded GMRES, SolAMG.c:128-135).
"""
from __future__ import annotations


class FaspError(RuntimeError):
    def __init__(self, code: int, message: str = ""):
        self.code = code
        super().__init__(f"[{code}] {message}" if message else f"[{code}]")


def chkerr(code: int, where: str = "") -> None:
    """Raise if ``code`` is a failure status (reference: fasp_chkerr)."""
    if code < 0:
        raise FaspError(code, where)
