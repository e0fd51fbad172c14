"""Logging and environment helpers of the port."""
