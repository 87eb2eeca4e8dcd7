"""Feature-phase primitives."""
