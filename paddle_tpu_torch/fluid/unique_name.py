"""paddle.fluid.unique_name — process-unique name generation (the port's
copy of ``paddle_tpu.utils.unique_name``; ref: fluid/unique_name.py
generate:84, switch:134, guard:187)."""
from __future__ import annotations

import contextlib

__all__ = ["generate", "guard", "switch", "UniqueNameGenerator"]


class UniqueNameGenerator:
    """Counter-per-prefix generator (ref: unique_name.py:33)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: dict = {}

    def __call__(self, key: str) -> str:
        tmp = self.ids.setdefault(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    """``key`` → ``key_<n>``, unique within the active generator."""
    return generator(key)


def switch(new_generator=None):
    """Swap the active generator, returning the old one."""
    global generator
    old = generator
    generator = new_generator if new_generator is not None \
        else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """Scope a fresh (or prefixed) generator: inside the guard, counters
    restart."""
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    elif isinstance(new_generator, bytes):
        new_generator = UniqueNameGenerator(new_generator.decode())
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
