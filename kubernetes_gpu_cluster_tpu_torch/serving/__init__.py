"""Serving front door (the asyncio engine wrapper)."""
