"""Helpers of the port that sit beside the query path."""
