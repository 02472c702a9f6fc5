"""Minimal CLI app base class (reference tartangan/utils/app.py:4-34)."""
from __future__ import annotations

import argparse


class App:
    app_name = "base app"

    def __init__(self, args):
        self.args = args

    def run(self):
        pass

    @classmethod
    def run_from_cli(cls):
        app = cls.create_from_cli()
        app.run()

    @classmethod
    def create_from_cli(cls):
        return cls(cls.parse_cli_args())

    @classmethod
    def parse_cli_args(cls, argv=None):
        p = argparse.ArgumentParser(
            description=cls.app_name, fromfile_prefix_chars="@"
        )
        cls.add_args_to_parser(p)
        return p.parse_args(argv)

    @classmethod
    def add_args_to_parser(cls, p):
        pass
