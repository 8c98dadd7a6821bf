"""The yardstick of the roofline shares: the card's published peaks and
the work (bytes and FP32 operations) of a pass, counted from the cell's
own inputs through the plain reference (``work``)."""
