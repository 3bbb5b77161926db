"""Moving batches to the device (one device; multi-device, not ported yet (ROADMAP.md))."""
