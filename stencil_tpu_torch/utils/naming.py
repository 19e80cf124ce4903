"""Name matching for the CLIs: fnmatch with literal-bracket tolerance.

PyTorch-port copy of ``stencil_tpu/utils/naming.py``. Tuner plan keys
and bench ids embed literal brackets (``PpermuteSlab[s=2]``,
``bench_exchange.megastep``), which collide with fnmatch's
character-class syntax: ``*[s=2]`` parses ``[s=2]`` as a character
class and never matches the literal name. ``glob_match`` tries the raw
pattern first and then a variant with every ``[`` escaped to the
``[[]`` character class.
"""

import fnmatch

__all__ = ["glob_match"]


def glob_match(name: str, pattern: str) -> bool:
    """True when ``name`` matches ``pattern`` as a glob, treating ``[``
    in the pattern as a literal bracket when the raw fnmatch reading
    fails. An exact string match always passes."""
    if name == pattern:
        return True
    if fnmatch.fnmatchcase(name, pattern):
        return True
    if "[" in pattern:
        return fnmatch.fnmatchcase(name, pattern.replace("[", "[[]"))
    return False
