"""Model configurations the port supports."""
