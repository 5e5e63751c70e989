"""Array operations of the chain and the publish, on torch tensors."""
