"""Process start to the first timed pass, in seconds."""

from benchmark.readers import setup_seconds as read  # noqa: F401
