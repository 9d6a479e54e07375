"""Settings file handling (INI format).

Parity: misopy/settings.py + misopy/settings/miso_settings.txt.
Defaults: burn_in=500, lag=10, num_iters=5000, num_chains=6,
min_event_reads=20, strand=fr-unstranded, filter_results=True.
"""
from __future__ import annotations

import configparser
import os
from typing import Dict, Optional

DEFAULT_SETTINGS = {
    "data": {
        "filter_results": "True",
        "min_event_reads": "20",
        "strand": "fr-unstranded",
    },
    "cluster": {},
    "sampler": {
        "burn_in": "500",
        "lag": "10",
        "num_iters": "5000",
        "num_chains": "6",
        "num_processors": "4",
    },
}


class Settings:
    """ConfigParser-backed singleton (misopy/settings.py:13-195)."""

    _instance: Optional["Settings"] = None

    def __init__(self, path: Optional[str] = None):
        self.parser = configparser.ConfigParser()
        for sec, kv in DEFAULT_SETTINGS.items():
            self.parser[sec] = dict(kv)
        self.path = path
        if path is not None:
            with open(path) as f:
                self.parser.read_file(f)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Settings":
        cls._instance = cls(path)
        return cls._instance

    @classmethod
    def get(cls) -> "Settings":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -------------------------------------------------------- accessors
    def get_sampler_params(self) -> Dict[str, int]:
        """Ref: settings.py:62-81."""
        s = self.parser["sampler"]
        return {
            "burn_in": s.getint("burn_in", 500),
            "lag": s.getint("lag", 10),
            "num_iters": s.getint("num_iters", 5000),
            "num_chains": s.getint("num_chains", 6),
        }

    def get_stop_rule(self) -> str:
        """'fixed' (MISO_STOP_FIXEDNO, the reference CLI behavior,
        miso_sampler.py:211) or 'convergent' (MISO_STOP_CONVMEAN with the
        adaptive extension, pysplicing/src/miso.c:903-928)."""
        return self.parser["sampler"].get("stop", "fixed")

    def get_max_iters(self) -> int:
        """Extension cap for the convergent stop rule (miso.c:908)."""
        return self.parser["sampler"].getint("max_iters", 500000)

    def get_min_event_reads(self) -> int:
        """Ref: settings.py:117."""
        return self.parser["data"].getint("min_event_reads", 20)

    def get_strand_param(self) -> str:
        """Ref: settings.py:129."""
        return self.parser["data"].get("strand", "fr-unstranded")

    def get_filter_results(self) -> bool:
        return self.parser["data"].getboolean("filter_results", True)

    def get_num_processors(self) -> int:
        """Ref: settings.py:148."""
        return self.parser["sampler"].getint("num_processors", 4)

    def get_cluster_command(self) -> Optional[str]:
        return self.parser["cluster"].get("cluster_command", None)


def load_settings(path: Optional[str] = None) -> Settings:
    return Settings.load(path)
