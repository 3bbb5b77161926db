"""The DualVGR network as torch modules, eval mode."""
