"""Operations and bytes of the published architecture."""
