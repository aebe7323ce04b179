"""ImageNet: schema, generator and the ResNet-50 example (torch twins)."""
