"""Operation, byte and FLOP counts, and the card's published peaks."""
