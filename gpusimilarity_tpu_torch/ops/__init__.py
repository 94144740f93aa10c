"""Scoring, top-k, folding rules and the bitplane phase-1 kernel wrapper."""
