"""Serving front door: the asyncio engine wrapper and the OpenAI HTTP
server on the standard-library HTTP layer ``serving/http.py`` (server and
client), with the fleet plane's replica side: the KV wire codec
(``serving/handoff.py``), the fleet prefix cache's policy
(``serving/fleet_cache.py``) and the ``/internal/*`` routes; and the
router (``serving/router.py``), the fleet's front door over N replicas;
and multi-rank serving (``serving/multihost.py``): rank 0's directive
broadcast to its tp/ep followers. Not ported yet: the interleave
sanitizer hook."""

__all__ = ["APIServer", "build_server", "Router"]


def __getattr__(name):
    # Imported on first use, so ``python -m ...serving.api_server`` does
    # not find the module already loaded by its own package, and a router
    # loads no engine.
    if name == "Router":
        from . import router
        return router.Router
    if name in __all__:
        from . import api_server
        return getattr(api_server, name)
    raise AttributeError(name)
