"""Core of the port: quantization, packed bit-serial engine, mapper, scheduler, simulator."""
