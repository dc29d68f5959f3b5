"""The torch wave engine and its policies."""
