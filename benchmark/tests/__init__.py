"""The benchmark's own tests (CPU; the card's are marked ``card``)."""
