"""One-off measurements on the card behind design choices of the port."""
