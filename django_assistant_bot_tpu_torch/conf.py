"""Settings of the port: the one flag its storage plane reads.

A copy of the JAX package's ``conf.py`` cut to ``ANN_DURABLE_DIR``, which
``cli ann``'s durable actions (``snapshot``, ``restore``, ``verify``) fall
back to when no ``--dir`` is given; the rest of that file's flags belong to
planes the port has not taken over (ROADMAP Queue 1 item 16).  ``_env``
reads the same environment names: ``DABT_<NAME>``, then ``<NAME>``.
``settings.override(...)`` is the test hook.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, Optional


def _env(name: str, default: Any = None) -> Any:
    return os.environ.get(f"DABT_{name}", os.environ.get(name, default))


class Settings:
    def __init__(self) -> None:
        self.reload()

    def reload(self) -> None:
        # durable retrieval plane (storage/durable.py): the base directory
        # under which `cli ann` finds a corpus's WAL + snapshot directory
        self.ANN_DURABLE_DIR: Optional[str] = _env("ANN_DURABLE_DIR")

    @contextlib.contextmanager
    def override(self, **kw) -> Iterator["Settings"]:
        old = {k: getattr(self, k) for k in kw}
        for k, v in kw.items():
            setattr(self, k, v)
        try:
            yield self
        finally:
            for k, v in old.items():
                setattr(self, k, v)


settings = Settings()
