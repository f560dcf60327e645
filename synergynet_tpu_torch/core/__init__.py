"""Shared plumbing: file locations, checkpoint loading and the device
rule of the entry points."""
