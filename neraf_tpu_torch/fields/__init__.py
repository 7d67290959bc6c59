"""Neural fields."""
