"""Moving batches to the device (one device; multi-device is ROADMAP item 4)."""
