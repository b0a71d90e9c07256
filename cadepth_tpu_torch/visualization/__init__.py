"""Depth colour maps and comparison panels."""
