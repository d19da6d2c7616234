"""Serving front door: the asyncio engine wrapper and the OpenAI HTTP
server on the standard-library HTTP layer ``serving/http.py`` (server and
client), with the fleet plane's replica side: the KV wire codec
(``serving/handoff.py``), the fleet prefix cache's policy
(``serving/fleet_cache.py``) and the ``/internal/*`` routes. Not ported
yet: the router (``serving/router.py`` of the JAX package; ROADMAP A6),
multihost serving (A7) and the interleave sanitizer hook."""

__all__ = ["APIServer", "build_server"]


def __getattr__(name):
    # Imported on first use, so ``python -m ...serving.api_server`` does
    # not find the module already loaded by its own package.
    if name in __all__:
        from . import api_server
        return getattr(api_server, name)
    raise AttributeError(name)
