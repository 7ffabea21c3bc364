"""Drivers of the traffic mixes, one module each (``traffic/*.json``
names its driver)."""
