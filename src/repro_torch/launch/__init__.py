"""Serving: the continuous-batching engine and the serve driver."""
