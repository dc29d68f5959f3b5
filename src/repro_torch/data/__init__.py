"""The synthetic packed-document data pipeline (numpy)."""
