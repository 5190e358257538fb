"""Helpers of the port that are not about models or data."""
