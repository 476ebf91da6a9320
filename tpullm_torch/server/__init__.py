"""The serving stack on the card: Scheduler (continuous batching over
runtime/batch_engine.py) and the OpenAI-compatible HTTP server."""

from .scheduler import GenRequest, Scheduler
