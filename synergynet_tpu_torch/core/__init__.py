"""Shared plumbing: file locations and checkpoint loading."""
