"""Drivers: one a configuration kind, found by the configuration's "kind"."""
