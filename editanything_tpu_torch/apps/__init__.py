"""Front-end helpers: the semantic-label overlay."""
