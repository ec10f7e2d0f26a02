"""Models of the port: :mod:`.gpt`."""
