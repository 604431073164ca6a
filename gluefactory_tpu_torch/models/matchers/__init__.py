"""Feature matchers."""
