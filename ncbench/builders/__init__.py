"""Builders of the program under test, one module per model family, named
by a configuration's ``builder`` key."""
