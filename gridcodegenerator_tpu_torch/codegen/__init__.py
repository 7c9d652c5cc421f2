"""Per-robot code generation (the ``gen_all_code()`` analog)."""

from .emit import ALGORITHMS, gen_all_code

__all__ = ["ALGORITHMS", "gen_all_code"]
