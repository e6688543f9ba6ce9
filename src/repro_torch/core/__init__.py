"""The NetRPC system on PyTorch: INC map, channels, pipeline, schema and
runtime."""
