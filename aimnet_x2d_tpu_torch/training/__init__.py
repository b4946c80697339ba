"""Prediction drivers.  Training itself is a later slice of the port."""
