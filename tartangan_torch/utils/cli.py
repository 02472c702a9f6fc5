"""CLI helpers: arg replay files and 'None'-coercing types.

Parity: reference tartangan/utils/cli.py:6-41.
"""
from __future__ import annotations

import sys

from .fs import smart_open


def save_cli_arguments(filename, fromfile_prefix="@", argv=None):
    """Save argv to an argparse ``@file`` for exact run replay.

    If the only argument is already an ``@file``, copy its contents
    (reference utils/cli.py:6-22).
    """
    args = list(argv) if argv is not None else sys.argv[1:]
    if args and args[0].startswith(fromfile_prefix):
        input_filename = args[0][1:]
        with smart_open(input_filename, "r") as infile:
            args = [line.strip() for line in infile.readlines()]

    with smart_open(filename, "w") as outfile:
        outfile.write("\n".join(args))


def type_or_none(default_type):
    """Convert the string 'None' to the value ``None``.

    >>> f = type_or_none(int)
    >>> f(None) is None
    True
    >>> f('None') is None
    True
    >>> f(123)
    123
    """
    def f(value):
        if value is None or value == "None":
            return None
        return default_type(value)
    return f


if __name__ == "__main__":
    import doctest

    doctest.testmod(verbose=True)
