"""Serving: the chunked wav -> .dac -> wav API."""
