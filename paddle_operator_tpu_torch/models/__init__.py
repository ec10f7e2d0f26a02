"""Models of the port: :mod:`.gpt`, :mod:`.resnet`."""
