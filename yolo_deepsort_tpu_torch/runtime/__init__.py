"""Host runtime of the port: video IO."""
