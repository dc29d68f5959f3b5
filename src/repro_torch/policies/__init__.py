"""Policy registry and ILP assignment resolution."""
