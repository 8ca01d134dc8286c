"""String-keyed agent registry: ``config.agent`` names the class to run.

Agents register under a name with :func:`register_agent`; the built-in
agent is registered under both of its config names on the first lookup,
so that reading a config stays light.
"""

from __future__ import annotations

from typing import Callable, Dict

_AGENTS: Dict[str, Callable] = {}


def register_agent(name: str):
    """Class decorator: ``get_agent(name)`` returns the class."""
    def deco(cls):
        _AGENTS[name] = cls
        return cls
    return deco


def get_agent(name: str):
    if name not in _AGENTS:
        from .train.loop import LiftingDWTAgent
        _AGENTS.setdefault("LiftingBasedDWTAgent", LiftingDWTAgent)
        _AGENTS.setdefault("CompressionAgent", LiftingDWTAgent)
    if name not in _AGENTS:
        raise KeyError(f"unknown agent {name!r}; known: {sorted(_AGENTS)}")
    return _AGENTS[name]
