"""Ray and hit types, vector math and ray sorting."""
