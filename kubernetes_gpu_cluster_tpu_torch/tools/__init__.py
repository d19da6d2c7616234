"""Scripts run on the card by hand (tuning sweeps); nothing here runs at import."""
