"""Query planning, merging, storage and training machinery."""
