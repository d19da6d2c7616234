"""Serving front door: the asyncio engine wrapper and the OpenAI HTTP
server (colocated serving, on the standard-library HTTP layer
``serving/http.py``). Not ported yet: the fleet plane (KV handoff wire,
router, fleet prefix cache; ROADMAP A6) and multihost serving (A7)."""

__all__ = ["APIServer", "build_server"]


def __getattr__(name):
    # Imported on first use, so ``python -m ...serving.api_server`` does
    # not find the module already loaded by its own package.
    if name in __all__:
        from . import api_server
        return getattr(api_server, name)
    raise AttributeError(name)
