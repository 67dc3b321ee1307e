"""Analysis of the port without a card: the roofline of a counted step."""
