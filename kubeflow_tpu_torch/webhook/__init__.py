"""The mutating webhook's image choice for an H100 slice."""
