"""Scheduler policies that trade work with the device: the ``tpu`` policy."""
