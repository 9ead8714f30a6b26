"""Simulator core: events, state, engine, stats and the streaming driver."""
