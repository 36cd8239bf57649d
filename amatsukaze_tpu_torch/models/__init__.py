"""Logo, telecine and filter-graph models (host decisions, device math)."""
