"""Forecasters of the port."""
