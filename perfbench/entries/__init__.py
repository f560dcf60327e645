"""Entries: how a cell's calls are made and their outputs read, one file
per entry point, found by the name a workload file gives."""
