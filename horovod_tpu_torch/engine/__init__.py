"""The port's collective engine: host C++ built at first use."""
