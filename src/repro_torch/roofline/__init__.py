"""repro_torch.roofline — the card's hardware table (``roofline.hw``)."""
