"""Reference SPI implementations (reference: accord/impl — SURVEY.md §2.7)."""
