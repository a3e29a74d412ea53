from honerf_torch.config.hocon import ConfigTree, load_config, parse_string

__all__ = ["ConfigTree", "load_config", "parse_string"]
