"""The read plane: scoped-index blocking queries served by a
parked-watcher multiplexer, with stale/consistent read modes layered
on in api/http.py (the port of the JAX package's readplane package;
README.md there describes the design)."""

from .mux import ParkedQuery, ReadMux

__all__ = ["ParkedQuery", "ReadMux"]
