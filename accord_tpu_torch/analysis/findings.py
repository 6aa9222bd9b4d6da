"""Finding model for accord-lint.

A finding's *baseline key* is deliberately line-number free — pass id,
file (relative to the package parent), qualname, code and a stable detail
string — so a baseline entry survives unrelated edits to the file and
goes stale only when the underlying construct moves or disappears.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Finding:
    pass_id: str        # blocking | determinism | threads | surface | layering
    file: str           # path relative to the package parent
    line: int
    qualname: str       # function/class qualname, or module name
    code: str           # short machine code, e.g. "blocking-call"
    message: str        # human text, includes the reach path where useful
    detail: str = ""    # stable discriminator (primitive name, attr, ...)

    @property
    def key(self) -> str:
        return "::".join((self.pass_id, self.file, self.qualname,
                          self.code, self.detail))

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.pass_id}/{self.code}] " \
               f"{self.qualname}: {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"pass": self.pass_id, "file": self.file, "line": self.line,
                "qualname": self.qualname, "code": self.code,
                "message": self.message, "detail": self.detail,
                "key": self.key}
