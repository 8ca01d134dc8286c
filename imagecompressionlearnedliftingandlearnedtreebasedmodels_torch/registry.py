"""String-keyed agent lookup: ``config.agent`` names the class to run."""

from __future__ import annotations


def get_agent(name: str):
    # imported late, so reading a config stays light
    from .train.loop import LiftingDWTAgent
    agents = {"LiftingBasedDWTAgent": LiftingDWTAgent,
              "CompressionAgent": LiftingDWTAgent}
    if name not in agents:
        raise KeyError(f"unknown agent {name!r}; known: {sorted(agents)}")
    return agents[name]
