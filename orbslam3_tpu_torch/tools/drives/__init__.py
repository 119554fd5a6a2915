"""Verification drives: long synthetic runs with their own gates."""
