"""Ray-sphere intersection and the brute-force oracle."""
