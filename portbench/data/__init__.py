"""Frozen context generators, read through each configuration's file."""
