"""The power-aware training runtime."""
